"""Share of the Krylov chunks, %, that ran as a CUDA graph replay: the
program's ``graph.replays`` over ``graph.replays`` + ``graph.warmups`` (a
key's first chunk, eager on the graph set's stream) + ``graph.eager``
(chunks no graph can run), over every solve of the run."""

from eigbench.counters import program_counters


def read(ctx):
    counted = program_counters() if ctx.cuda else None
    if counted is None:
        return None
    chunks = sum(counted.get(f"graph.{k}", 0) for k in ("replays", "warmups", "eager"))
    if not chunks:
        return None
    return 100.0 * counted.get("graph.replays", 0) / chunks
