"""``train_mfu``: the model FLOPs of the window's updates and actions
(training steps and evaluations), forward and backward, counted from the
nets' shapes (``counts/flops.py``), over the window's host seconds and
the H100 SXM's 67 TFLOP/s of float32 outside the tensor cores (the port
pins full float32, TF32 off), in percent."""


def read(trace):
    c = trace.counts
    if not c.get("window_flops") or not c.get("window_s"):
        return None
    return 100.0 * c["window_flops"] / c["window_s"] / c["peak_flops_per_s"]
