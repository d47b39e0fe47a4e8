"""Launchers: ``serve`` (batched prefill + KV-cache decode), ``train``, and
``mesh`` (the ``distributed`` backend's device meshes)."""
