"""The work each entry's call does, by layer, from its shapes and dtypes
alone: bytes (each input read once, each output written once) and
operations (5 n log2 n per complex DFT of n points, half that for a real
one), whatever implements it.  One module per entry, named as the entry;
each gives ``layers(shape, in_dtype, kwargs)``."""
