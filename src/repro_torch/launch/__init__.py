"""Launchers of the port: ``serve`` (continuous-batching decode loop)."""
