"""Batchers: real pages a det wave (DetPageBatcher's wave function),
over the waves that started in the window."""


def read(run):
    waves = run.det_waves()
    if not waves:
        return None
    return sum(len(w[2]) for w in waves) / len(waves)
