"""Math kernels on tensors: Schechter forms, completeness, Omega,
quadrature, and the CUDA likelihood kernels (``cuda_lnlike``)."""
