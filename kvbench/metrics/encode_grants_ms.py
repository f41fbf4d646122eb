"""Milliseconds a verification in the program's ``encode.grants`` spans,
both directions, less their children: the grant rows and their port masks
(host clock, from the span log). Read as ``encode_grants_ms.verify``."""
from kvbench import program_spans


def read(run):
    return program_spans.self_ms(run, "encode.grants") if run.kind == "verify" else None
