"""Native (C++) host-side code of the port, each piece beside a Python
version that is its specification:

  * obj_loader.cpp: the OBJ parse core (``models/obj_loader.py``
    ``_load_obj_native``), built at first use with g++ into ``_build/``
    and loaded through ctypes (``build.py``).

``RE_TPU_NATIVE=0`` forces the Python versions.
"""
