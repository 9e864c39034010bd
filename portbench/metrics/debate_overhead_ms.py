"""The debate layer's own time a round (``debate/core.py`` ``run_round``):
the round's wall less the engine ``chat`` walls inside it, in ms, the
mean over the window's rounds."""


def read(run):
    rounds = run["rounds"]
    if not rounds:
        return None
    return 1e3 * sum(r["wall_s"] - r["chat_s"] for r in rounds) / len(rounds)
