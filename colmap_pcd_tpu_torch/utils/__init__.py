"""Host runtime: options, logging, timing, native C++ bindings."""
