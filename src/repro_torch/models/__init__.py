"""Model stack of the port: config, parameters, layers, attention, model."""
