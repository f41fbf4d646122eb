"""Milliseconds a verification in the program's ``encode.labels`` span, less
its children: the vocabulary, the label matrices, the namespace index and
the policies' selector stack (host clock, from the span log). Read as
``encode_labels_ms.verify``."""
from kvbench import program_spans


def read(run):
    return program_spans.self_ms(run, "encode.labels") if run.kind == "verify" else None
