"""The example and validation scripts of ``examples/`` on the PyTorch port.

One module per script of ``examples/``, under the same name, each runnable
alone (``python examples_torch/<name>.py``, on the card) or imported as
``examples_torch.<name>`` and called with ``device="cpu"``.  The package
keeps the port's modules out of the top-level names (``_common``,
``pv_european_option``, ...) that the JAX scripts take in ``sys.modules``.
"""
