"""Input generation from the run's seed."""
