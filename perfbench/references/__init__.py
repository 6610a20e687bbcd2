"""Plain references, one module per distance, found by the distance name
in a configuration's file.  Each module gives ``pair_distances(x, y,
dtype)`` over row-aligned pairs and ``CONTROL``, the guarantee-breaking
or lower-precision variant that the control check runs.  They import
nothing of the program."""
