"""Stream syncs a call of the log posterior: the ``syncs`` the port counts
in the spans under its ``logpost`` spans (the base parameters'
host-to-device copies, ``logpost.params``), over those calls, in the
profiled slice."""

from benchlib.program_spans import calls, in_slice, under


def read(run):
    spans = in_slice(run)
    n_calls = len(calls(spans, "logpost"))
    if not n_calls:
        return None
    syncs = sum(s.counts.get("syncs", 0) for s in under(spans, "logpost"))
    return syncs / n_calls
