"""Serving engine, KV pool, scheduler, requests, workload and the typed
construction API."""
