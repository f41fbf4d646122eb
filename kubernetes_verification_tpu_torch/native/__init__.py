"""The port's native (C++) components.

The port's own copy of ``kubernetes_verification_tpu.native``: the
packed-bitset engine ``bitset.cpp`` (byte for byte the JAX package's),
compiled with the host's ``g++`` on demand into the package's gitignored
``_build/`` directory, and ``binding.py`` exposing it via ctypes. Importing
this package is safe without a compiler; importing :mod:`.binding` raises
``NativeUnavailable`` instead.
"""
