"""Dense generate's prefill a round (``engine/generate.py``): the sum of
the rows' ``Usage.prefill_time_s``, which is the call's
``GenerateResult.prefill_time_s``; the mean over the window's rounds."""


def read(run):
    if run["traffic"]["kv"] != "dense" or not run["rounds"]:
        return None
    rounds = run["rounds"]
    return sum(sum(x["prefill_s"] for x in r["rows"]) for r in rounds) / len(rounds)
