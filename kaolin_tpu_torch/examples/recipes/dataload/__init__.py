"""The dataload recipes."""
