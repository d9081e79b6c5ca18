"""Host-side native code of the port: the C++ SAH / MTBVH builder."""
