"""restir_ms: device time a frame of ReSTIR DI, the program's span ``restir``
(children ``restir.generate``, ``restir.temporal``, ``restir.spatial<k>``,
``restir.shade``), ms."""
from quakebench import programtrace


def read(run):
    return programtrace.span_ms("restir")
