from smatcher.oracles.reference import (
    oracle_ac,
    oracle_sh,
    oracle_sbom,
    oracle_wm,
    oracle_sog,
    ORACLES,
)

__all__ = ["oracle_ac", "oracle_sh", "oracle_sbom", "oracle_wm", "oracle_sog", "ORACLES"]
