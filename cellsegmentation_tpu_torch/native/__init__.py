"""Host-side native code (C++ through ctypes), built at first use."""
