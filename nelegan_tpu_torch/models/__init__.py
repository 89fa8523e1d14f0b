"""Generator, spectral-norm discriminators and weight import."""
