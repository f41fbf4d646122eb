"""Milliseconds a verification in the program's ``encode.ports`` span, less
its children: the port atoms and the named-port resolution (host clock, from
the span log); nothing where the encoding computes no ports. Read as
``encode_ports_ms.verify``."""
from kvbench import program_spans


def read(run):
    return program_spans.self_ms(run, "encode.ports") if run.kind == "verify" else None
