"""Serving core of the port: KV slot-pool, engine, scheduler."""
