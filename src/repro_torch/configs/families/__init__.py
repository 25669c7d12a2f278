"""Family records of the configurations and their cell programs."""
