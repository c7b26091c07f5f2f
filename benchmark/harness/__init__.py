"""The benchmark's general code: the spec loader, the traffic drivers, the
spans and the device trace, the roofline counts, the judge."""
