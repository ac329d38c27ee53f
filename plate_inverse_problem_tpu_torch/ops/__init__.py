"""Device operators of the port: flat SpMV, RCM band layout and its CUDA
band kernel, the two-grid preconditioner and the mixed-precision sweep."""
