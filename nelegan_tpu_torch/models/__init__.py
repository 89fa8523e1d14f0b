"""Generator and weight import."""
