"""Serving — the inline continuous-batching scheduler and its facade."""
