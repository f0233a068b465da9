"""CUDA-runtime calls that wait for the device (stream or device
synchronize, synchronous ``cudaMemcpy*``) inside a single solve's
``lmpc.mpc.control`` span, a call (satellite-single)."""

from mpcbench import spans


def read(ctx):
    sp = spans.named(spans.program_spans(ctx), "lmpc.mpc.control")
    if not sp:
        return None
    return spans.host_events_inside(ctx, sp, spans.is_sync) / len(sp)
