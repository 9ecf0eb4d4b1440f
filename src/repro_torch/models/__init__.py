"""The LM stack: layers, GQA attention over the flash/paged kernels, the
Mamba-2 SSD block over the scan kernel, the dense and Mamba-2 decoder
stacks, and the conversion of the JAX package's parameter trees."""
