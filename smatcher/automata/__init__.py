from smatcher.automata.ac import ACTables, build_ac
from smatcher.automata.sh import SHTables, build_sh
from smatcher.automata.sbom import SBOMTables, build_sbom
from smatcher.automata.wu import WMTables, build_wm
from smatcher.automata.sog import SOGTables, build_sog
from smatcher.automata.verify import VerifyTables, build_verify
from smatcher.automata.kmp import pre_kmp, kmp_count
from smatcher.automata.bm import pre_bm_bc

__all__ = [
    "pre_kmp", "kmp_count", "pre_bm_bc",
    "ACTables", "build_ac",
    "SHTables", "build_sh",
    "SBOMTables", "build_sbom",
    "WMTables", "build_wm",
    "SOGTables", "build_sog",
    "VerifyTables", "build_verify",
]
