"""Host utilities: dtypes, PPM I/O, render statistics."""
