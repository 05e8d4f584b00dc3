"""The harness's general parts: the loops, the profile, the check."""
