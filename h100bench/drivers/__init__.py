"""One module per entry that a window drives, found by the name a cell's
file gives. Each has ``setup(cfg, cell, seed, device)`` (build the program
and the inputs, warm up every shape the window uses), ``window(state,
seconds, tracer)`` (the timed loop; a record of it) and ``check(state,
record)`` (the comparison with the plain reference, once the program's
state is freed)."""
