"""cond_prepare_s: host seconds of the set-up's voice conditioning
(``prepare_conditionals``, or VC's ``set_target_voice``), ending in a sync."""


def read(run):
    return run.setup.get("cond_prepare_s")
