"""Serving front-ends over the port's engine and continuous batcher."""
