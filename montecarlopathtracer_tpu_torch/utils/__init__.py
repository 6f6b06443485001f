"""Host utilities: PNG I/O and render logging."""
