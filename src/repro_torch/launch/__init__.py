"""Launchers: ``serve`` (batched prefill + KV-cache decode)."""
