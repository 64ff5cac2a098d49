"""``host_syncs_per_chunk``: the count of the program's span
``cm3.host_sync`` (each host read of a device value on the lockstep
loop) over the count of ``cm3.chunk``, read from the record the port
keeps of its ``cm3.*`` spans (``cm3_tpu_torch.utils.profiling.summary``,
{span path: {"count", ...}}) in this process after the traced stretch,
whose profiler turned the spans on and started the record afresh; 0
where the chunks ran with no such read.  A program that keeps no such
record, or one without ``cm3.chunk``, gives None.  A count, so the
profiler's own cost does not move it."""


def read(trace):
    try:
        from cm3_tpu_torch.utils import profiling
    except ImportError:
        return None
    summary = getattr(profiling, "summary", None)
    rec = summary() if callable(summary) else None
    if not rec:
        return None
    count = lambda span: sum(v["count"] for path, v in rec.items()
                             if path.split("/")[-1] == span)
    chunks = count("cm3.chunk")
    return count("cm3.host_sync") / chunks if chunks else None
