"""Config extensions: one module an architecture whose keys the default
tree (``defaults.py``, equal to the JAX package's) lacks, each with
``add_config(cfg)``, which adds them with their defaults. ``get_cfg``
applies every module here in sorted name order."""
