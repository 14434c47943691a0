"""Percent of the traced window's forward step-graph runs that replayed a
captured graph (train/graphs.py's graph.replays.forward counter, of its
eager runs, captures and replays)."""

from benchmark.port_readers import replay_pct, traced


def read(ctx):
    return replay_pct(ctx, "forward", traced())
