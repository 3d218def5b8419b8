"""Serving stack of the port: paged KV arena, executors, engine, loop."""
