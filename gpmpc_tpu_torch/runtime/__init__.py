# The reference's NativeOcpSolver and build_native_library (the C++ oracle's
# loader) are not ported yet (ROADMAP.md Queue 1 item 10).
__all__ = []
