"""Count the instructions of the occupation kernel's pieces in SASS.

Run from the root of a checkout, on a machine with the CUDA toolkit
(nvcc and cuobjdump; no card needed):

    python3 scripts/torch_occupation_sass.py [--out build/sass/occupation_sass.json]

It compiles one probe kernel per piece of ``csrc/occupation.cu`` with the
port's nvcc flags (sm_90a, -O3, no fast math) into ``build/sass/``, the
probe source including ``occupation.cu`` itself so that every piece is the
kernel's own device code: each libm call alone (float64 exp, exp10, log,
log10, log1p, erfc, atan, tgamma, division and reciprocal; float32 exp10f,
__exp10f, division, __fdividef), and the kernel's per-node steps (a
float32 Newton step, the float64 Newton step, the central erfc, the
satellites' power law, the decoration, the quadrature FMA, Gamma(a, x)'s
series and continued-fraction terms, ...).  ``cuobjdump -sass`` of each
probe gives its instructions from the entry to the first EXIT (the line
the common case runs; nvcc places libdevice's rare-case paths after the
EXIT), less the same count of a probe that only loads and stores.  Each
instruction is classed as FP64 pipe (D* arithmetic and compares, MUFU.*64H,
conversions to or from F64), FP32 (FADD, FMUL, FFMA, FSETP, FMNMX, MUFU,
...), or other (integer, moves, selects, branches, memory).

Prints one JSON object, {piece: {"fp64": n, "fp32": n, "other": n,
"branches": n, "rare": n}} ("branches": conditional branches on the common
line, "rare": instructions after the EXIT), and writes it to ``--out``.
chip_smoke.py's ``occupation_bound`` takes its FP64 and FP32 counts.
"""

import argparse
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from tabcorr_tpu_torch.utils.build import CSRC, NVCC_FLAGS, nvcc_path  # noqa

# name -> (result type, body).  A body reads double inputs a[k], float
# inputs af[k] and int inputs ai[k] and sets the result r (double) or rf
# (float); a value it must keep live beside the result it stores in
# out[x + 32 * k] or outf[x + 32 * k].  A Shmr (the inversion's row terms)
# is made of inputs, as the kernel holds it in registers.
SHMR = ("Shmr s = {a[0], a[1], a[2], a[3], a[4], a[5], af[0], af[1], "
        "af[2], af[3], af[4], af[5]}; ")
PIECES = {
    "load_store": ("double", "r = a[0];"),
    "load_store_f32": ("float", "rf = af[0];"),
    # libm, one call each
    "exp": ("double", "r = exp(a[0]);"),
    "exp10": ("double", "r = exp10(a[0]);"),
    "log": ("double", "r = log(a[0]);"),
    "log10": ("double", "r = log10(a[0]);"),
    "log1p": ("double", "r = log1p(a[0]);"),
    "erfc": ("double", "r = erfc(a[0]);"),
    "atan": ("double", "r = atan(a[0]);"),
    "tgamma": ("double", "r = tgamma(a[0]);"),
    "ddiv": ("double", "r = a[0] / a[1];"),
    "drcp": ("double", "r = 1.0 / a[0];"),
    "exp10f": ("float", "rf = exp10f(af[0]);"),
    "fast_exp10f": ("float", "rf = __exp10f(af[0]);"),
    "fdiv": ("float", "rf = af[0] / af[1];"),
    "fast_fdiv": ("float", "rf = __fdividef(af[0], af[1]);"),
    # the kernel's steps (occupation.cu)
    "bisection_step": ("float", SHMR + "float lo = af[6], hi = af[7]; "
                       "const float mid = 0.5f * (lo + hi); "
                       "if (shmr_log_mh_fast(s, mid) > af[8]) hi = mid; "
                       "else lo = mid; rf = lo; outf[x + 32] = hi;"),
    "newton_f32_step": ("float", SHMR + "float df; rf = newton_f(s, af[6], "
                        "af[7], &df); outf[x + 32] = df;"),
    "newton_f64_step": ("double", SHMR + "const double x0 = af[6]; "
                        "r = x0 - (shmr_log_mh(s, x0) - a[6]) / "
                        "static_cast<double>(af[7]);"),
    "leauthaud11_erfc": ("double",
                         "r = 0.5 * erfc((a[0] - a[1]) * a[2]);"),
    "zu15_erfc": ("double", "const double dln = kLn10 * (a[0] - a[1]); "
                  "double s = a[2] + a[3] * (dln > 0.0 ? dln : 0.0); "
                  "s = s > kSigmaFloor ? s : kSigmaFloor; "
                  "r = 0.5 * erfc(kLn10 * (a[4] - a[5]) / (kSqrt2 * s));"),
    "satellite_power": ("double", "r = exp(a[0] * (a[1] - a[2]) - "
                        "exp10(a[3] - a[1]));"),
    "multiply": ("double", "r = a[0] * a[1];"),
    "tinker13_mix": ("double", "r = a[0] * a[1] + (1.0 - a[0]) * a[2];"),
    "decorate_bounded": ("double", "OccArgs A = {}; A.ratio = a[4]; "
                         "A.below_scale = a[5]; r = decorate(a[0], a[1], "
                         "ai[0] & 1, true, a[3], A);"),
    "decorate_unbounded": ("double", "OccArgs A = {}; A.ratio = a[4]; "
                           "A.below_scale = a[5]; r = decorate(a[0], a[1], "
                           "ai[0] & 1, false, 1.0, A);"),
    "quadrature_fma": ("double", "r = fma(a[0], static_cast<double>(af[0]), "
                       "a[1]);"),
    "node_abscissa": ("double", "r = static_cast<double>(af[0]) + "
                      "static_cast<double>(af[1]);"),
    "cacciato09_luminosity": ("double", "const double t = a[0] - a[1]; "
                              "const double l = fmax(t, 0.0) + log1p(exp10("
                              "-fabs(t))) / kLn10; r = a[2] + a[3] * t - "
                              "(a[3] - a[4]) * l;"),
    "cacciato09_central_erfc": ("double",
                                "r = 0.5 * erfc((a[0] - a[1]) * a[2]);"),
    "cacciato09_satellite_terms": (
        "double", "const double m12 = a[0] - 12.0; "
        "const double log_ls = a[1] + kLog10_0562; "
        "const double alpha_sat = -2.0 + a[2] * (1.0 - (2.0 / kPi) * "
        "atan(a[3] * (a[0] - a[4]))); "
        "const double log_phi = a[5] + a[6] * m12 + a[7] * m12 * m12; "
        "const double log_delta = a[8] + a[9] * m12; "
        "const double s = 0.5 * (alpha_sat + 1.0); "
        "out[x + 32] = s; "
        "out[x + 64] = exp10(log_delta + 2.0 * (a[10] - log_ls)); "
        "r = 0.5 * exp10(log_phi - s * log_delta) * a[11];"),
    "gamma_entry": ("double", "r = fmax(a[1], kGammaXFloor); "
                    "outf[x + 32] = a[0] >= kGammaTol;"),
    "gamma_series_term": ("double", "const double ap = a[0] + 1.0; "
                          "const double term = a[1] * (a[2] / ap); "
                          "r = a[3] + term; out[x + 32] = term; "
                          "out[x + 64] = ap; outf[x + 32] = "
                          "fabs(term) < fabs(r) * 1e-17;"),
    "gamma_series_ends": ("double", "const double lnx = log(a[1]); "
                          "outf[x + 32] = a[1] < a[0] + 1.0; "
                          "out[x + 32] = 1.0 / a[0]; r = tgamma(a[0]) - "
                          "a[2] * exp(a[0] * lnx - a[1]);"),
    "gamma_fraction_term": (
        "double", "const int n = ai[0]; const double an = -n * (n - a[0]); "
        "const double bn = a[1] + 2.0; double d = an * a[2] + bn; "
        "if (fabs(d) < 1e-300) d = 1e-300; double c = bn + an / a[3]; "
        "if (fabs(c) < 1e-300) c = 1e-300; d = 1.0 / d; "
        "const double del = d * c; r = a[4] * del; out[x + 32] = d; "
        "out[x + 64] = c; out[x + 96] = bn; "
        "outf[x + 32] = fabs(del - 1.0) < 1e-16;"),
    "gamma_fraction_ends": ("double", "const double lnx = log(a[1]); "
                            "outf[x + 32] = a[1] < a[0] + 1.0; "
                            "out[x + 32] = 1.0 / (a[1] + 1.0 - a[0]); "
                            "r = exp(a[0] * lnx - a[1]) * a[2];"),
    "gamma_negative_a": ("double", "const double a_lo = fmin(a[0], "
                         "-kGammaTol); out[x + 32] = a_lo + 1.0; "
                         "r = (a[1] - exp(a_lo * log(a[2]) - a[2])) / "
                         "a_lo;"),
}


def probe_source():
    lines = [f'#include "{CSRC / "occupation.cu"}"', ""]
    for name, (typ, body) in PIECES.items():
        store = "out[x] = r;" if typ == "double" else "outf[x] = rf;"
        lines += [f'extern "C" __global__ void probe_{name}(',
                  "    const double* in, double* out, float* outf) {",
                  "  const int x = threadIdx.x;",
                  "  const double* a = in + x * 32;",
                  "  const float* af = reinterpret_cast<const float*>("
                  "a + 16);",
                  "  const int* ai = reinterpret_cast<const int*>(a + 24);",
                  "  double r;",
                  "  float rf;",
                  f"  {body}",
                  f"  {store}",
                  "}", ""]
    return "\n".join(lines)


FP64_OPS = {"DADD", "DMUL", "DFMA", "DSETP", "DSET", "DMNMX"}
FP32_OPS = {"FADD", "FMUL", "FFMA", "FSETP", "FSET", "FMNMX", "FCHK",
            "FRND", "FADD32I", "FMUL32I", "FFMA32I", "MUFU", "F2F"}
CONVERSIONS = {"F2F", "F2I", "I2F", "FRND"}
INSTRUCTION = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(.*?)\s*;")


def classify(text):
    """(class, is conditional branch, is an unpredicated EXIT) of one SASS
    instruction."""
    predicated = text.startswith("@")
    words = text.split()
    op = words[1] if predicated else words[0]
    base, *mods = op.split(".")
    if base in FP64_OPS or (base == "MUFU" and any("64H" in m for m in mods)) \
            or (base in CONVERSIONS and any("F64" in m for m in mods)):
        kind = "fp64"
    elif base in FP32_OPS:
        kind = "fp32"
    else:
        kind = "other"
    return kind, base == "BRA" and predicated, base == "EXIT" and \
        not predicated


def count(sass):
    """{probe: counts} from cuobjdump -sass output."""
    out, name, done = {}, None, False
    for line in sass.splitlines():
        m = re.search(r"Function : probe_(\w+)", line)
        if m:
            name, done = m.group(1), False
            out[name] = {"fp64": 0, "fp32": 0, "other": 0, "branches": 0,
                         "rare": 0}
            continue
        m = INSTRUCTION.search(line)
        if name is None or not m:
            continue
        kind, branch, exit_ = classify(m.group(1))
        c = out[name]
        if done:
            c["rare"] += 1
            continue
        c[kind] += 1
        c["branches"] += int(branch)
        done = exit_
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=str(ROOT / "build" / "sass" /
                                         "occupation_sass.json"))
    args = ap.parse_args()
    work = ROOT / "build" / "sass"
    work.mkdir(parents=True, exist_ok=True)
    src = work / "probes.cu"
    src.write_text(probe_source())
    cubin = work / "probes.cubin"
    flags = [f for f in NVCC_FLAGS if f not in ("-shared", "-Xcompiler",
                                                "-fPIC", "-Xptxas", "-v")]
    subprocess.run([nvcc_path(), *flags, "-cubin", "-o", str(cubin),
                    str(src)], check=True)
    cuobjdump = Path(nvcc_path()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(cubin)], check=True,
                          capture_output=True, text=True).stdout
    (work / "probes.sass").write_text(sass)
    raw = count(sass)
    result = {}
    for name, c in raw.items():
        if name.startswith("load_store"):
            continue
        base = raw["load_store_f32" if PIECES[name][0] == "float"
                   else "load_store"]
        result[name] = {k: c[k] - (base[k] if k in ("fp64", "fp32", "other")
                                   else 0) for k in c}
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(result, indent=1))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
