"""The kernel rows of the traced run, one file a kind, found by name
(``manifest.kernel_kinds``). ``kernels/<kind>.py`` gives:

* ``PROFILER_NAME``: a part of the kernel's name in the profiler's rows,
  and ``EXCLUDE``: a part the name must not hold, or None;
* ``WRAPS``: ``"module:function"``, the port's wrapper whose calls launch
  the kernel; an eager run of each frame program records them;
* ``work(*args, **kwargs)``: for a call of the wrapper with these
  arguments, ``{"bytes", "ops", ...}``, the least the kernel must move and
  compute, or None where the call launches another kind's kernel (K1's
  two modes share one wrapper).

The bound of a call is ``bounds.bound(bytes, ops)``."""
