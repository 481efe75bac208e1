"""The mean wall of the engine's prefill call, timed by the benchmark's
wrapper, which synchronises the card before it stops the clock."""


def read(run):
    walls = run.span_walls("engine.prefill")
    if not walls:
        return None
    return sum(walls) / len(walls) * 1e3
