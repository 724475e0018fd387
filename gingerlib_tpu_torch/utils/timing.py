"""Device time of a launch on the card, without the host's cost per launch."""

import torch


def graph_ms(fn, reps: int) -> float:
    """Device milliseconds of one call of ``fn``: ``reps`` calls captured
    into one CUDA graph (the wrappers launch on the current stream) and the
    graph replayed between CUDA events, so that the host's cost per launch,
    which timing back-to-back calls includes, drops out."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()                          # warm-up, outside the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    graph.replay()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps
