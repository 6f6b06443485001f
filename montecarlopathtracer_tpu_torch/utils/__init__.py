"""Host utilities: PNG I/O, render logging and profiling."""
