"""Typed run configuration.

Mirrors the key surface and defaults of the reference's `LDAConfiguration`
interface (configuration/LDAConfiguration.java:10-246; key reference in
resources/configuration/Configuration-README.txt). The reference exposes ~80
typed getters over an INI file; here the same keys are fields of one frozen
dataclass with identical defaults, and `ini.py` populates it from the same
INI format (global scope + `[subconfig]` sections + `configs=` list).

Additions of the JAX package live at the bottom (mesh shape, token block
size, dtype) — they have no reference counterpart. The port keeps the whole
key surface, so one INI file drives both packages, and adds `device`: the
torch device the port runs on ("cuda" unless the run asks for "cpu").
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Sequence


@dataclass
class LDAConfig:
    # --- identity / bookkeeping (tui/ParallelLDA.java run loop) ----------
    title: str = "TPU-LDA"
    description: str = ""
    active_subconfig: str = "default"
    no_runs: int = 1
    experiment_out_dir: str = "runs"

    # --- data (util/LDAUtils.java loaders) -------------------------------
    dataset: Optional[str] = None
    test_dataset: Optional[str] = None
    # LDATrainTestConfiguration.getTextDatasetTestIdsFilename
    # (configuration/LDATrainTestConfiguration.java)
    test_ids_filename: Optional[str] = None
    folds: int = 2                     # cross-validation folds (tui drivers)
    stoplist: Optional[str] = "stoplist.txt"
    rare_threshold: int = 0            # RARE_WORD_THRESHOLD
    tfidf_vocab_size: int = -1         # TF_IDF_VOCAB_SIZE_DEFAULT
    file_regex: str = r".*\.txt$"      # FILE_REGEX_DEFAULT
    keep_numbers: bool = False         # NumericAlsoTokenizer selection
    keep_connecting_punctuation: bool = False  # KEEP_CONNECTING_PUNCTUATION
    max_doc_buf_size: int = 10000      # MAX_DOC_BUFFFER_SIZE_DEFAULT

    # --- model (LDAConfiguration.java:10-56 defaults) --------------------
    scheme: str = "ggs"
    topics: int = 10                   # NO_TOPICS_DEFAULT
    alpha: float = 5.0                 # ALPHA_DEFAULT = 50/topics
    beta: float = 0.01                 # BETA_DEFAULT
    iterations: int = 1500             # NO_ITER_DEFAULT
    seed: int = 0                      # SEED_DEFAULT (0 => clock time)
    symmetric_alpha: bool = False      # SYMMETRIC_ALPHA_DEFAULT
    hyperparam_optim_interval: int = -1
    # HDP family
    hdp_gamma: float = 1.0             # HDP_GAMMA_DEFAULT
    hdp_start_topics: int = 1          # HDP_START_TOPICS_DEFAULT
    hdp_k_percentile: float = 0.8      # HDP_K_PERCENTILE
    # psi sampler for the ppu_hdplda scheme: "gem" (GEMBasedPsiSampler,
    # the reference default, PoissonPolyaUrnHDPLDA.java:116) or "poisson"
    # (PoissonBasedPsiSampler :342-400).
    hdp_psi_sampler: str = "gem"
    # new-topic index prior Gamma: "geometric" (GeometricGamma(1/(1+gamma)),
    # the reference default :111) or "uniform" (UniformGamma :505-520).
    hdp_gamma_dist: str = "geometric"
    # static per-iteration budget of topic-birth candidate draws (the
    # Poisson(gamma) count is truncated here to keep shapes static; at the
    # default gamma=1, P(n_add > 32) < 1e-35).
    hdp_birth_budget: int = 32

    # --- run control ------------------------------------------------------
    exec_time: int = 10                # EXEC_TIME_DEFAULT (seconds budget)
    batches: int = 4                   # NO_BATCHES_DEFAULT (z parallelism)
    topic_batches: int = 2             # NO_TOPIC_BATCHES_DEFAULT
    document_sampler_split_limit: int = 100
    results_size: int = 1

    # --- random scan (randomscan/*) --------------------------------------
    batch_building_scheme: str = "even"     # EVEN_SPLIT default
    percentage_split_size_doc: float = 1.0
    fixed_split_size_doc: Sequence[float] = field(default_factory=tuple)
    instability_period: int = 0
    topic_batch_building_scheme: str = "even"
    percentage_split_size_topic: float = 1.0
    # MetaTopicIndexBuilder's sub-builder list (sub_topic_index_builders key)
    sub_topic_index_builders: Sequence[str] = field(default_factory=tuple)
    topic_index_building_scheme: str = "all"  # ALL default
    full_phi_period: int = 5
    percent_top_tokens: float = 0.2

    # --- sparse-Dirichlet plug point (types/*) ---------------------------
    sparse_dirichlet_sampler_builder_name: str = "marsaglia"
    alias_poisson_threshold: int = 100  # ALIAS_POISSON_DEFAULT_THRESHOLD

    # --- priors (SpaliasUncollapsedParallelWithPriors) -------------------
    topic_prior_filename: Optional[str] = None

    # --- diagnostics / logging cadence -----------------------------------
    topic_interval: int = -1           # TOPIC_INTER_DEFAULT (-1 = never)
    start_diagnostic: int = 500        # START_DIAG_DEFAULT
    diagnostic_interval: Sequence[int] = field(default_factory=tuple)
    dn_diagnostic_interval: Sequence[int] = field(default_factory=tuple)
    compute_likelihood: bool = True    # COMPUTE_LIKELIHOOD
    compute_doc_topic_distances: bool = False
    measure_timing: bool = False
    debug: int = 0
    log_type_topic_density: bool = False
    log_document_density: bool = False
    log_phi_density: bool = False
    log_tokens_per_topic: bool = False

    # --- artifact dumping (tui/ParallelLDA.java:210-302) -----------------
    print_phi: bool = False
    save_phi: bool = False
    save_phi_means: bool = False       # SAVE_PHI_MEAN_DEFAULT
    phi_mean_burnin: int = 0           # PHI_BURN_IN_DEFAULT (percent)
    phi_mean_thin: int = 1             # PHI_THIN_DEFAULT
    phi_mean_filename: str = "phi_means.csv"
    save_doc_topic_means: bool = False
    doc_topic_mean_filename: str = "doc_topic_means.csv"
    save_doc_theta_estimate: bool = False
    doc_topic_theta_filename: str = "doc_topic_theta.csv"
    save_vocabulary: bool = False
    vocabulary_filename: str = "lda_vocab.txt"
    save_term_frequencies: bool = False
    term_frequencies_filename: str = "term_frequencies.txt"
    save_doc_lengths: bool = False
    doc_lengths_filename: str = "doc_lengths.txt"
    save_corpus: bool = False
    print_ndocs_interval: Sequence[int] = field(default_factory=tuple)
    print_ndocs_cnt: int = 0
    print_ntopwords_interval: Sequence[int] = field(default_factory=tuple)
    print_ntopwords_cnt: int = 0
    no_top_words: int = 20             # NO_TOP_WORDS_DEFAULT
    lambda_relevance: float = 0.6      # LAMBDA_DEFAULT ("lambda" key)

    # --- TPU-native knobs (no reference counterpart) ---------------------
    # torch device of the PyTorch port: "cuda" (the default; an error when
    # no CUDA device is present) or "cpu" (the kernels' plain versions).
    device: str = "cuda"
    mesh_shape: Sequence[int] = field(default_factory=tuple)  # () = 1 chip
    mesh_axis_names: Sequence[str] = ("data",)
    token_block: int = 4096        # tokens per sweep block (4096 measured +17% over 2048 on the fused GGS kernel: fewer grid steps amortise per-block PRNG/zeroing)
    vocab_span: int = 128          # aligned type-window width (GGS blocks)
    doc_span: int = 128            # aligned doc-window width (GGS n_dk path)
    doc_length_multiple: int = 8   # doc-major padding multiple
    paranoid: bool = False         # run count invariants every iteration
    scan_chunk: int = 1            # iterations fused per captured group
    prng_impl: str = "rbg"         # "rbg" (fast on TPU) or "threefry2x32"
    zdraw_kernel: str = "auto"     # the JAX package's z-draw choice, kept
    #   for its INI key: the port reads it nowhere. The card always runs
    #   csrc/zdraw.cu, the CPU its plain version; zdraw_precise selects
    #   the f32 tables.
    zdraw_precise: bool = False    # fused kernel: bf16x2 tables + f32 cdf
    aliasmh_rounds: int = 2        # ggs_aliasmh: word+doc MH round pairs per sweep (large-K O(1)-per-token z-step; more rounds = better mixing, linear cost)
    aliasmh_packed: str = "auto"   # ggs_aliasmh table layout: "packed" [.,2] f32 rows (1 gather/eval, +8*(VK+DK) bytes) | "unpacked" (2 gathers/eval, zero extra memory) | "auto" = packed while the extra stays within 4 GiB

    def replace(self, **kw) -> "LDAConfig":
        return dataclasses.replace(self, **kw)

    @property
    def alpha_sum(self) -> float:
        """alpha is per-topic (NOT the sum), Configuration-README.txt:48."""
        return self.alpha * self.topics

    def effective_seed(self) -> int:
        """seed==0 or -1 means clock time (LDAConfiguration.java:19,
        Configuration-README.txt:45)."""
        if self.seed in (0, -1):
            import time
            return int(time.time() * 1000) & 0x7FFFFFFF
        return self.seed
