"""Device operators of the port: flat SpMV, RCM band layout and its CUDA
band kernel, the two-grid preconditioner, the mixed-precision sweep and
the modal and direct sweeps."""
