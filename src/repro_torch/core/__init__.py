"""RAP core: memory model, masks, GSI scoring, DQN controller, policies."""
