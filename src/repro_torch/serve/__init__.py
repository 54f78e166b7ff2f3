"""Deployment export and the continuous-batching serving engine."""
