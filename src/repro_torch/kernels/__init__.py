"""Hand-written CUDA kernels of the port, their plain PyTorch versions, and
the wrappers that dispatch between them by device (``ops``); and the
Vecchia family's blocked k-NN search (``knn``), plain PyTorch: it ports
no Pallas kernel."""
