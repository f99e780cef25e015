"""Profile data set accessor.

The pipeline's knowledge base (reference profile/ layer, SURVEY.md §L5):

    CDS_HMM/{clade}.hmm        13 PCG DNA profile HMMs per clade
    CDS_HMM/required_cds.json  expected nucleotide length per PCG per clade
    MT_database/{clade}.fa     per-clade mito protein DBs (tblastn)
    tRNA_CM/Metazoa_{AA}.cm    22 tRNA covariance models
    rRNA_CM/12s.cm 16s.cm      rRNA covariance models
    codes.json                 clade -> NCBI genetic code default

This loader treats the directory as data (point it at a MitoFlex profile
directory or any compatible layout); nothing is bundled in the repo. All
parses are cached per path.
"""

from __future__ import annotations

import json
import os
from functools import lru_cache
from typing import Dict, List, Optional

from . import cm as cm_models
from . import hmm as hmm_models
from . import proteindb


class ProfileSet:
    def __init__(self, profile_dir: str):
        if not os.path.isdir(profile_dir):
            raise FileNotFoundError(f"profile directory not found: {profile_dir}")
        self.dir = profile_dir

    # ---- clades -----------------------------------------------------
    def clades(self) -> List[str]:
        d = os.path.join(self.dir, "CDS_HMM")
        return sorted(
            os.path.splitext(f)[0] for f in os.listdir(d) if f.endswith(".hmm")
        )

    @lru_cache(maxsize=None)
    def cds_hmms(self, clade: str) -> List[hmm_models.ProfileHMM]:
        return hmm_models.load_hmm_file(os.path.join(self.dir, "CDS_HMM", f"{clade}.hmm"))

    @lru_cache(maxsize=None)
    def required_cds(self, clade: str) -> Dict[str, int]:
        with open(os.path.join(self.dir, "CDS_HMM", "required_cds.json")) as f:
            return json.load(f)[clade]

    @lru_cache(maxsize=None)
    def genetic_code(self, clade: str) -> int:
        with open(os.path.join(self.dir, "codes.json")) as f:
            return int(json.load(f)[clade])

    # ---- protein DBs ------------------------------------------------
    @lru_cache(maxsize=None)
    def protein_db(self, clade: str) -> List[proteindb.ProteinRecord]:
        return proteindb.load_protein_db(
            os.path.join(self.dir, "MT_database", f"{clade}.fa")
        )

    @lru_cache(maxsize=None)
    def merged_protein_db(self) -> List[proteindb.ProteinRecord]:
        """The regenerated 'Animal.fa' union (findmitoscaf.py:112-121)."""
        return proteindb.load_merged(self.dir)

    # ---- RNA models -------------------------------------------------
    @lru_cache(maxsize=None)
    def trna_cms(self) -> Dict[str, "cm_models.CovarianceModel"]:
        d = os.path.join(self.dir, "tRNA_CM")
        out = {}
        for f in sorted(os.listdir(d)):
            if f.endswith(".cm"):
                key = os.path.splitext(f)[0].split("_")[-1]  # amino letter
                models = cm_models.load_cm_file(os.path.join(d, f))
                if models:
                    out[key] = models[0]
        return out

    @lru_cache(maxsize=None)
    def rrna_cms(self) -> Dict[str, "cm_models.CovarianceModel"]:
        d = os.path.join(self.dir, "rRNA_CM")
        out = {}
        for name in ("12s", "16s"):
            p = os.path.join(d, f"{name}.cm")
            if os.path.exists(p):
                models = cm_models.load_cm_file(p)
                if models:
                    out[name] = models[0]
        return out


_DEFAULT: Optional[ProfileSet] = None


def get_profiles(profile_dir: Optional[str] = None) -> ProfileSet:
    global _DEFAULT
    if profile_dir:
        return ProfileSet(profile_dir)
    if _DEFAULT is None:
        env = os.environ.get("MITOFLEX_TPU_PROFILE_DIR")
        if env:
            _DEFAULT = ProfileSet(env)
        else:
            raise FileNotFoundError(
                "No profile directory configured: set run.profile_dir or "
                "MITOFLEX_TPU_PROFILE_DIR"
            )
    return _DEFAULT
