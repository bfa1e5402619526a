"""ssmm_exchange_ms: device time a frame of SSMM's chain exchange, the
program's span ``ssmm.exchange`` (the roll of the tentative chains and the
scored reads of the previous frame's states, each sample; not the frame's
inputs they gather from, which are ``ssmm.inputs``), ms."""
from quakebench import programtrace


def read(run):
    return programtrace.span_ms("ssmm.exchange")
