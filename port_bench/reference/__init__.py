"""The plain reference the benchmark holds the port to.

Written from the engine's specification (the semantics of the JAX
package's demo, step and renderer, which nothing here imports) as plain
PyTorch: ``demo`` builds the scene from the seed, ``step`` ticks the
world, ``render`` makes the shadow maps and the image,
``programs/space.py`` drives them (the ``space`` program's ``Reference``
and ``Control``), ``frames`` reads the program's states; ``precision``
holds the lower-precision control. Another program's reference is
``programs/<name>.py``. The station's OBJ, MTL and images are raw files
under ``assets/``. Nothing here imports the port."""
