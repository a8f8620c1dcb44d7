"""The benchmark's yardstick: peaks and bounds, work counters, percentiles,
the traffic generator and the reduction of a profiler trace. Frozen copies,
so that later changes to the program do not move them."""
