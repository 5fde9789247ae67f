"""Miniapp tree: ``apps/<app>/<variant>.py``, as in the JAX package."""
