"""The spc recipes."""
