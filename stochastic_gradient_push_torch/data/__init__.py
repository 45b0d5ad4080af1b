"""Training data (numpy copies of the reference's generators)."""
