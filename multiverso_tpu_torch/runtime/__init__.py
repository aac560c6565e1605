"""The native host runtime of the port (``runtime/src/*.cpp``), built with
``g++`` at first use and loaded through ``ctypes`` (:mod:`.ffi`)."""
