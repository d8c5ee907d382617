"""CPU tests of the benchmark: its generator, reference, comparison,
roofline arithmetic, result line and imports, and the control and faults
that the comparison must catch, at sizes a test run holds."""
