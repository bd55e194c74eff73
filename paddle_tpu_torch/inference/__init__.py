"""Serving: host page accounting (``paging``) and the continuous-batching
engine (``serving.ContinuousBatcher``)."""
