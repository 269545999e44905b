"""The camera recipes."""
