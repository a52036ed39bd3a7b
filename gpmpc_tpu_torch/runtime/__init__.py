from gpmpc_tpu_torch.runtime.native import NativeOcpSolver, build_native_library

__all__ = ["NativeOcpSolver", "build_native_library"]
