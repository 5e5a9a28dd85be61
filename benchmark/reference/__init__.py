"""The plain float32 reference of the burn-in LM: imports nothing of the
program."""
