"""Device operations: the Gram kernel and its build, block Cholesky inverse, PCG."""
