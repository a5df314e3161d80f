"""The benchmark's harness: the manifest and the files it names, the
measured window, spans and the device trace, the roofline yardstick, the
traffic generator and the comparison that decides ``correct``."""
