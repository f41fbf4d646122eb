"""Share of the port lookups in the program's ``encode.grants`` spans, both
directions, that a table of the same encode served rather than computed:
100 × (1 − Σ ``port_builds`` / Σ ``port_lookups``) (program counters, from
the span log). Read as ``encode_port_reuse.verify``; nothing where no lookup
was counted (an any-port encode, or a program that does not count them)."""
from kvbench import program_spans


def read(run):
    if run.kind != "verify":
        return None
    lookups = program_spans.attr_per_step(run, "encode.grants", "port_lookups")
    if not lookups:
        return None
    builds = program_spans.attr_per_step(run, "encode.grants", "port_builds")
    return 100.0 * (1.0 - builds / lookups)
