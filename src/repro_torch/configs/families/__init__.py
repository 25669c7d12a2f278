"""Family records of the configurations (the LM family so far)."""
