"""Peak device memory over set-up and window, GB (10^9 bytes), as the CUDA
caching allocator reports it (torch.cuda.max_memory_allocated)."""


def read(run):
    return run.peak_bytes / 1e9
