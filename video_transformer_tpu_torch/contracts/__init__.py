"""Output contracts: the parts the training path needs."""
