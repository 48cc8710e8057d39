"""Device-mesh sharding: the dp x tp recognizer training step's layout."""
