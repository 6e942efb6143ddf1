"""The host runtime in C++ beside the device work: the threaded PNG prefetch
loader and the exact covisibility graph (native_lib.py, native/)."""
