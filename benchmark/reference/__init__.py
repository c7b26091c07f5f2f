"""Plain reference of what the benchmark's cells judge.

Written from the published semantics of x42's phaserotate (the CLI's
offline search, cli/phase-rotate.cc, and the LV2 plugin's streaming
engine and meters, src/phaserotate.c) in numpy and plain torch.  It
imports nothing of the program: the FIR design, the angle tables, the
sweep, the selection, the stream and the meters are frozen copies kept
here, and every derived quantity (taps, spectra, tables, the angle ramp)
is worked out again from the inputs the benchmark makes.
"""
