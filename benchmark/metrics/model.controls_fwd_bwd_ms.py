"""Device ms of one forward and backward of the frame-rate NN at the
cell's batch and frames (CUDA events around graph replays)."""


def read(run):
    s = run.layer.get("controls_fwd_bwd_s")
    return None if s is None else 1e3 * s
