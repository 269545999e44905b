"""The preprocess recipes."""
