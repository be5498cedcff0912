"""The engine's wall time of a wave in the window (its group's solve,
polish and copy back: ``MapResponse.seconds * batch_size``, the engine's
own host clock), total over count."""


def read(run):
    waves = {(a.pass_no, a.bucket): a.seconds * a.batch_size
             for a in run.window}
    return sum(waves.values()) / len(waves) if waves else None
