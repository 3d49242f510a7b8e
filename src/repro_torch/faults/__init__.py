"""Fault detection — the artifact checksum run at lane commissioning."""
