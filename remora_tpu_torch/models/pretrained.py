"""ONT pretrained model registry + download.

Copy of ``remora_tpu/models/pretrained.py`` (reference analog
``constants.MODEL_DICT`` + ``download.py``). Stored here
as a flat table of released model identifiers (pore, basecall type,
basecall version, modified bases, motif, remora version, artifact name);
defaults resolve to the first matching row. Downloaded TorchScript
artifacts import through remora_tpu_torch.models.model_io.
"""

from pathlib import Path

from remora_tpu_torch import RemoraError, log

LOGGER = log.get_logger()

CDN_URL = "https://cdn.oxfordnanoportal.com/software/analysis/remora/"

# (pore, modified_bases, motif, bc_type, bc_ver, remora_ver, name)
PRETRAINED_MODELS = [
    # R9 5mC CG
    ("dna_r9.4.1_e8", "5mc", "CG", "sup", "v3.5.1", 0,
     "dna_r9.4.1_e8_sup_v3.5.1_5mc_CG_v0"),
    ("dna_r9.4.1_e8", "5mc", "CG", "hac", "v3.5.1", 0,
     "dna_r9.4.1_e8_hac_v3.5.1_5mc_CG_v0"),
    ("dna_r9.4.1_e8", "5mc", "CG", "fast", "v3.5.1", 0,
     "dna_r9.4.1_e8_fast_v3.5.1_5mc_CG_v0"),
    # kit14 400bps 5mC all-context
    ("dna_r10.4.1_e8.2_400bps", "5mc", "C", "sup", "v4.2.0", 2,
     "dna_r10.4.1_e8.2_5khz_400bps_sup_v4.2.0_5mc_v2"),
    ("dna_r10.4.1_e8.2_400bps", "5mc", "C", "sup", "v4.0.1", 2,
     "res_dna_r10.4.1_e8.2_4khz_400bps_sup_v4.0.1_5mc_v2"),
    # kit14 400bps 5mC CG
    ("dna_r10.4.1_e8.2_400bps", "5mc", "CG", "sup", "v4.2.0", 2,
     "dna_r10.4.1_e8.2_5khz_400bps_sup_v4.2.0_5mc_CG_v2"),
    ("dna_r10.4.1_e8.2_400bps", "5mc", "CG", "sup", "v4.1.0", 2,
     "dna_r10.4.1_e8.2_4khz_400bps_sup_v4.1.0_5mc_CG_v2"),
    ("dna_r10.4.1_e8.2_400bps", "5mc", "CG", "sup", "v3.5.1", 2,
     "dna_r10.4.1_e8.2_400bps_sup_v3.5.1_5mc_CG_v2"),
    ("dna_r10.4.1_e8.2_400bps", "5mc", "CG", "hac", "v4.2.0", 2,
     "dna_r10.4.1_e8.2_5khz_400bps_hac_v4.2.0_5mc_CG_v2"),
    ("dna_r10.4.1_e8.2_400bps", "5mc", "CG", "hac", "v4.1.0", 2,
     "dna_r10.4.1_e8.2_4khz_400bps_hac_v4.1.0_5mc_CG_v2"),
    ("dna_r10.4.1_e8.2_400bps", "5mc", "CG", "hac", "v3.5.1", 2,
     "dna_r10.4.1_e8.2_400bps_hac_v3.5.1_5mc_CG_v2"),
    ("dna_r10.4.1_e8.2_400bps", "5mc", "CG", "fast", "v4.2.0", 2,
     "dna_r10.4.1_e8.2_5khz_400bps_fast_v4.2.0_5mc_CG_v2"),
    ("dna_r10.4.1_e8.2_400bps", "5mc", "CG", "fast", "v4.1.0", 2,
     "dna_r10.4.1_e8.2_4khz_400bps_fast_v4.1.0_5mc_CG_v2"),
    ("dna_r10.4.1_e8.2_400bps", "5mc", "CG", "fast", "v3.5.1", 2,
     "dna_r10.4.1_e8.2_400bps_fast_v3.5.1_5mc_CG_v2"),
    # kit14 400bps 6mA all-context
    ("dna_r10.4.1_e8.2_400bps", "6ma", "A", "sup", "v5.0.0", 1,
     "dna_r10.4.1_e8.2_400bps_sup@v5.0.0_6mA@v1"),
    ("dna_r10.4.1_e8.2_400bps", "6ma", "A", "sup", "v4.3.0", 1,
     "dna_r10.4.1_e8.2_400bps_sup@v4.3.0_6mA@v1"),
    ("dna_r10.4.1_e8.2_400bps", "6ma", "A", "sup", "v4.2.0", 3,
     "dna_r10.4.1_e8.2_5khz_400bps_sup_v4.2.0_6ma_v3"),
    ("dna_r10.4.1_e8.2_400bps", "6ma", "A", "sup", "v4.2.0", 2,
     "dna_r10.4.1_e8.2_5khz_400bps_sup_v4.2.0_6ma_v2"),
    ("dna_r10.4.1_e8.2_400bps", "6ma", "A", "sup", "v4.0.1", 2,
     "res_dna_r10.4.1_e8.2_4khz_400bps_sup_v4.0.1_6mA_v2"),
    ("dna_r10.4.1_e8.2_400bps", "6ma", "A", "hac", "v5.0.0", 1,
     "dna_r10.4.1_e8.2_400bps_sup@v5.0.0_6mA@v1"),
    ("dna_r10.4.1_e8.2_400bps", "6ma", "A", "hac", "v4.3.0", 1,
     "dna_r10.4.1_e8.2_400bps_sup@v4.3.0_6mA@v1"),
    # kit14 400bps 5hmC+5mC CG
    ("dna_r10.4.1_e8.2_400bps", "5hmc_5mc", "CG", "sup", "v4.3.0", 1,
     "dna_r10.4.1_e8.2_400bps_sup@v4.3.0_5mCG_5hmCG@v1"),
    ("dna_r10.4.1_e8.2_400bps", "5hmc_5mc", "CG", "sup", "v4.2.0", 3,
     "dna_r10.4.1_e8.2_5khz_400bps_sup_v4.2.0_5hmc_5mc_CG_v3"),
    ("dna_r10.4.1_e8.2_400bps", "5hmc_5mc", "CG", "sup", "v4.2.0", 2,
     "dna_r10.4.1_e8.2_5khz_400bps_sup_v4.2.0_5hmc_5mc_CG_v2"),
    ("dna_r10.4.1_e8.2_400bps", "5hmc_5mc", "CG", "sup", "v4.1.0", 2,
     "dna_r10.4.1_e8.2_4khz_400bps_sup_v4.1.0_5hmc_5mc_CG_v2"),
    ("dna_r10.4.1_e8.2_400bps", "5hmc_5mc", "CG", "sup", "v4.0.0", 2,
     "dna_r10.4.1_e8.2_400bps_sup_v4.0.0_5hmc_5mc_CG_v2"),
    ("dna_r10.4.1_e8.2_400bps", "5hmc_5mc", "CG", "hac", "v4.3.0", 1,
     "dna_r10.4.1_e8.2_400bps_hac@v4.3.0_5mCG_5hmCG@v1"),
    ("dna_r10.4.1_e8.2_400bps", "5hmc_5mc", "CG", "hac", "v4.2.0", 2,
     "dna_r10.4.1_e8.2_5khz_400bps_hac_v4.2.0_5hmc_5mc_CG_v2"),
    ("dna_r10.4.1_e8.2_400bps", "5hmc_5mc", "CG", "hac", "v4.1.0", 2,
     "dna_r10.4.1_e8.2_4khz_400bps_hac_v4.1.0_5hmc_5mc_CG_v2"),
    ("dna_r10.4.1_e8.2_400bps", "5hmc_5mc", "CG", "hac", "v4.0.0", 2,
     "dna_r10.4.1_e8.2_400bps_hac_v4.0.0_5hmc_5mc_CG_v2"),
    ("dna_r10.4.1_e8.2_400bps", "5hmc_5mc", "CG", "fast", "v4.2.0", 2,
     "dna_r10.4.1_e8.2_5khz_400bps_fast_v4.2.0_5hmc_5mc_CG_v2"),
    ("dna_r10.4.1_e8.2_400bps", "5hmc_5mc", "CG", "fast", "v4.1.0", 2,
     "dna_r10.4.1_e8.2_4khz_400bps_fast_v4.1.0_5hmc_5mc_CG_v2"),
    ("dna_r10.4.1_e8.2_400bps", "5hmc_5mc", "CG", "fast", "v4.0.0", 2,
     "dna_r10.4.1_e8.2_400bps_fast_v4.0.0_5hmc_5mc_CG_v2"),
    # kit14 400bps 5hmC+5mC all-context
    ("dna_r10.4.1_e8.2_400bps", "5hmc_5mc", "C", "sup", "v5.0.0", 1,
     "dna_r10.4.1_e8.2_400bps_sup@v5.0.0_5mC_5hmC@v1"),
    ("dna_r10.4.1_e8.2_400bps", "5hmc_5mc", "C", "sup", "v4.3.0", 1,
     "dna_r10.4.1_e8.2_400bps_sup@v4.3.0_5mC_5hmC@v1"),
    ("dna_r10.4.1_e8.2_400bps", "5hmc_5mc", "C", "sup", "v4.2.0", 1,
     "dna_r10.4.1_e8.2_5khz_400bps_sup_v4.2.0_5hmc_5mc_v1"),
    ("dna_r10.4.1_e8.2_400bps", "5hmc_5mc", "C", "hac", "v5.0.0", 1,
     "dna_r10.4.1_e8.2_400bps_sup@v5.0.0_5mC_5hmC@v1"),
    ("dna_r10.4.1_e8.2_400bps", "5hmc_5mc", "C", "hac", "v4.3.0", 1,
     "dna_r10.4.1_e8.2_400bps_sup@v4.3.0_5mC_5hmC@v1"),
    # kit14 400bps 4mC+5mC all-context
    ("dna_r10.4.1_e8.2_400bps", "4mc_5mc", "C", "sup", "v5.0.0", 1,
     "dna_r10.4.1_e8.2_400bps_sup@v5.0.0_5mC_4mC@v1"),
    ("dna_r10.4.1_e8.2_400bps", "4mc_5mc", "C", "sup", "v4.3.0", 1,
     "res_dna_r10.4.1_e8.2_400bps_sup@v4.3.0_4mC_5mC@v1"),
    ("dna_r10.4.1_e8.2_400bps", "4mc_5mc", "C", "hac", "v5.0.0", 1,
     "dna_r10.4.1_e8.2_400bps_sup@v5.0.0_5mC_4mC@v1"),
    # kit14 260bps 5hmC+5mC CG
    ("dna_r10.4.1_e8.2_260bps", "5hmc_5mc", "CG", "sup", "v4.0.0", 2,
     "dna_r10.4.1_e8.2_260bps_sup_v4.0.0_5hmc_5mc_CG_v2"),
    ("dna_r10.4.1_e8.2_260bps", "5hmc_5mc", "CG", "hac", "v4.0.0", 2,
     "dna_r10.4.1_e8.2_260bps_hac_v4.0.0_5hmc_5mc_CG_v2"),
    ("dna_r10.4.1_e8.2_260bps", "5hmc_5mc", "CG", "fast", "v4.0.0", 2,
     "dna_r10.4.1_e8.2_260bps_fast_v4.0.0_5hmc_5mc_CG_v2"),
    # RNA004
    ("rna004_130bps", "m6a", "DRACH", "sup", "v3.0.1", 1,
     "rna004_130bps_sup@v3.0.1_m6A_DRACH@v1"),
    ("rna004_130bps", "m6a", "A", "sup", "v5.0.0", 1,
     "rna004_130bps_sup@v5.0.0_m6A@v1"),
    ("rna004_130bps", "m6a", "A", "hac", "v5.0.0", 1,
     "rna004_130bps_hac@v5.0.0_m6A@v1"),
    ("rna004_130bps", "pseU", "T", "sup", "v5.0.0", 1,
     "rna004_130bps_sup@v5.0.0_pseU@v1"),
    ("rna004_130bps", "pseU", "T", "hac", "v5.0.0", 1,
     "rna004_130bps_hac@v5.0.0_pseU@v1"),
    ("rna004_130bps", "inosine", "A", "sup", "v5.0.0", 1,
     "rna004_130bps_sup@v5.0.0_inosine@v1"),
]

HEADER = (
    "Pore",
    "Modified_Bases",
    "Remora_Model_Type",
    "Basecall_Model_Type",
    "Basecall_Model_Version",
    "Remora_Model_Version",
    "Model_Name",
)


def model_data_dir():
    path = Path(__file__).parent / "trained_models"
    path.mkdir(parents=True, exist_ok=True)
    return path


def get_pretrained_models(pore=None, basecall_model_type=None,
                          basecall_model_version=None, modified_bases=None,
                          remora_model_type=None, remora_model_version=None):
    """Filtered rows of the pretrained registry + header."""
    rows = list(PRETRAINED_MODELS)
    if pore is not None:
        rows = [r for r in rows if r[0] == pore.lower()]
    if modified_bases is not None:
        mb = "_".join(sorted(x.lower() for x in modified_bases))
        rows = [r for r in rows if r[1] == mb]
    if remora_model_type is not None:
        rows = [r for r in rows if r[2].upper() == remora_model_type.upper()]
    if basecall_model_type is not None:
        rows = [r for r in rows if r[3] == basecall_model_type.lower()]
    if basecall_model_version is not None:
        rows = [r for r in rows if r[4] == basecall_model_version]
    if remora_model_version is not None:
        rows = [r for r in rows if r[5] == int(remora_model_version)]
    if not rows:
        raise RemoraError("No models found satisfying filter criteria")
    out = [(r[0], r[1], r[2], r[3], r[4], r[5], r[6]) for r in rows]
    return out, list(HEADER)


def resolve_pretrained_model(pore=None, basecall_model_type=None,
                             basecall_model_version=None, modified_bases=None,
                             remora_model_type=None,
                             remora_model_version=None):
    """Resolve flags to a local model path, downloading when absent."""
    if pore is None:
        raise RemoraError("Must specify a pore.")
    if modified_bases is None:
        raise RemoraError("Must specify a modified base.")
    rows, _hdr = get_pretrained_models(
        pore=pore,
        basecall_model_type=basecall_model_type,
        basecall_model_version=basecall_model_version,
        modified_bases=modified_bases,
        remora_model_type=remora_model_type,
        remora_model_version=remora_model_version,
    )
    name = rows[0][-1]
    full_path = model_data_dir() / f"{name}.pt"
    if not full_path.exists():
        LOGGER.info(
            f"No pre-trained model found locally for this configuration; "
            f"attempting to download {name}"
        )
        download_model(name)
    return str(full_path)


def download_model(name):
    import urllib.request

    url = f"{CDN_URL}{name}.pt"
    dest = model_data_dir() / f"{name}.pt"
    LOGGER.info(f"Downloading {url}")
    try:
        urllib.request.urlretrieve(url, dest)
    except Exception as e:
        raise RemoraError(f"Failed to download model {name}: {e}")
    LOGGER.info(f"Model saved to {dest}")
    return dest


def download_models(pore=None, basecall_model_type=None,
                    basecall_model_version=None, modified_bases=None,
                    remora_model_type=None, remora_model_version=None):
    rows, _hdr = get_pretrained_models(
        pore=pore,
        basecall_model_type=basecall_model_type,
        basecall_model_version=basecall_model_version,
        modified_bases=modified_bases,
        remora_model_type=remora_model_type,
        remora_model_version=remora_model_version,
    )
    for row in rows:
        download_model(row[-1])
