"""Live serving: the engine, the async device and the DeepRT bridge."""
