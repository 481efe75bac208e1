"""The mean wall of the engine's decode call (one lockstep token for
every slot), timed by the benchmark's wrapper, which synchronises the
card before it stops the clock."""


def read(run):
    walls = run.span_walls("engine.decode")
    if not walls:
        return None
    return sum(walls) / len(walls) * 1e3
