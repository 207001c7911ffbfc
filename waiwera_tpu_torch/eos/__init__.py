"""Equations of state (counterpart of waiwera_tpu/eos). Regions are
frozen inside property evaluations and change only in the explicit
transition pass (doc/dev/code/index.md:37-39)."""

from waiwera_tpu_torch.eos.base import EOS


def from_json(config: dict, thermo, relperm, capillarity) -> EOS:
    """EOS selection from the JSON 'eos.name' value, "we" by default
    (eos_setup.F90)."""
    spec = config.get("eos", {})
    if isinstance(spec, str):
        spec = {"name": spec}
    name = spec.get("name", "we").lower()
    if name == "w":
        from waiwera_tpu_torch.eos.w import EOSWater

        return EOSWater(config, thermo, relperm, capillarity)
    if name == "we":
        from waiwera_tpu_torch.eos.we import EOSWaterEnergy

        return EOSWaterEnergy(config, thermo, relperm, capillarity)
    if name in ("wge", "wae", "wce"):
        from waiwera_tpu_torch.eos.wge import EOSWaterGasEnergy

        return EOSWaterGasEnergy(config, thermo, relperm, capillarity, name)
    if name == "wse":
        from waiwera_tpu_torch.eos.wse import EOSWaterSaltEnergy

        return EOSWaterSaltEnergy(config, thermo, relperm, capillarity)
    if name in ("wsge", "wsae", "wsce"):
        from waiwera_tpu_torch.eos.wsge import EOSWaterSaltGasEnergy

        return EOSWaterSaltGasEnergy(config, thermo, relperm, capillarity,
                                     name)
    raise ValueError(f"unknown EOS: {name!r}")
