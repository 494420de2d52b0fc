"""INI config parsing with subconfig activation.

Mirrors ParsedLDAConfiguration / SubConfig (configuration/SubConfig.java:22-67,
configuration/ParsedLDAConfiguration.java): an INI file with

  - a *global* scope (keys before any section header),
  - named `[subconfig]` sections listed in the global `configs = a, b, c` key,
  - key lookup resolving the *active* subconfig's keys first, falling back to
    the global scope (`translateKey`, SubConfig.java:57-67),
  - `#` comments, including trailing comments after values,
  - comma-separated lists for array-valued keys.

`ParsedConfig.activate(name)` returns a typed `LDAConfig` for that subconfig
(the reference mutates shared state via `activateSubconfig`; we stay
functional and hand back an immutable snapshot per subconfig).
"""

from __future__ import annotations

from dataclasses import fields

from ldagroupedgibbssampler_tpu_torch.config.lda_config import LDAConfig

# Reference key name -> LDAConfig field where they differ.
_KEY_ALIASES = {
    "lambda": "lambda_relevance",
    "hyperparam_optim_interval": "hyperparam_optim_interval",
    "cores": "batches",
}

_INT_LIST_KEYS = {"diagnostic_interval", "dn_diagnostic_interval",
                  "print_ndocs_interval", "print_ntopwords_interval",
                  "mesh_shape"}
_FLOAT_LIST_KEYS = {"fixed_split_size_doc"}
_STR_LIST_KEYS = {"mesh_axis_names"}

# Reference FQCN scheme names -> our short builder names
# (BatchBuilderFactory.java:20-45, TopicIndexBuilderFactory.java:11-14).
_CLASSNAME_MAP = {
    "evensplitbatchbuilder": "even",
    "percentagebatchbuilder": "percentage",
    "adaptivebatchbuilder": "adaptive",
    "fixedsplitbatchbuilder": "fixed",
    "evensplittopicbatchbuilder": "even",
    "percentagetopicbatchbuilder": "percentage",
    "allwordstopicindexbuilder": "all",
    "deltantopicindexbuilder": "delta_n",
    "mandelbrottopicindexbuilder": "mandelbrot",
    "proportionaltopicindexbuilder": "proportional",
    "topwordsrandomfractiontopicindexbuilder": "top_words_random_fraction",
    "mixedmandelbrotdeltantopicindexbuilder": "mixed_mandelbrot_delta_n",
    "marsagliasparsedirichlet": "marsaglia",
    "defaultsparsedirichletsamplerbuilder": "marsaglia",
    "polyaurndirichletsamplerbuilder": "polyaurn",
    "polyaurnfixedcoeffpoissondirichletsamplerbuilder": "polyaurn_fixed",
}


def _strip_comment(line: str) -> str:
    # '#' starts a comment unless inside nothing fancy (reference INI allows
    # trailing comments: "seed = -1 # -1 => use LSB of current time").
    idx = line.find("#")
    return line if idx < 0 else line[:idx]


def _parse_scalar(field_type: str, key: str, raw: str):
    raw = raw.strip()
    if key in _INT_LIST_KEYS:
        if raw in ("-1", ""):
            return ()
        return tuple(int(x) for x in raw.split(",") if x.strip())
    if key in _FLOAT_LIST_KEYS:
        return tuple(float(x) for x in raw.split(",") if x.strip())
    if key in _STR_LIST_KEYS:
        return tuple(x.strip() for x in raw.split(",") if x.strip())
    if field_type == "bool" or field_type == "Optional[bool]":
        return raw.lower() in ("true", "1", "yes", "on")
    if field_type == "int":
        return int(float(raw))
    if field_type == "float":
        return float(raw)
    # class-name-valued keys map to short names
    low = raw.rsplit(".", 1)[-1].lower()
    if low in _CLASSNAME_MAP:
        return _CLASSNAME_MAP[low]
    return raw


class ParsedConfig:
    """Raw parsed INI: global dict + per-section dicts, in file order."""

    def __init__(self, global_scope: dict, sections: dict, path: str = ""):
        self.global_scope = global_scope
        self.sections = sections
        self.path = path

    def sub_config_names(self) -> list[str]:
        configs = self.global_scope.get("configs", "")
        if configs:
            return [c.strip() for c in configs.split(",") if c.strip()]
        return list(self.sections)

    def activate(self, name: str, overrides: dict | None = None) -> LDAConfig:
        """Build an LDAConfig with subconfig keys shadowing global keys
        (SubConfig.translateKey semantics, SubConfig.java:57-67)."""
        merged = dict(self.global_scope)
        merged.update(self.sections.get(name, {}))
        if overrides:
            merged.update(overrides)
        merged.pop("configs", None)

        field_types = {f.name: f.type for f in fields(LDAConfig)}
        kwargs = {"active_subconfig": name}
        unknown = {}
        for key, raw in merged.items():
            fname = _KEY_ALIASES.get(key, key)
            if fname in field_types:
                kwargs[fname] = _parse_scalar(str(field_types[fname]),
                                              fname, str(raw))
            else:
                unknown[key] = raw
        cfg = LDAConfig(**kwargs)
        cfg.extra_keys = unknown  # preserved for forward-compat / logging
        return cfg


def parse_ini(path: str) -> ParsedConfig:
    global_scope: dict = {}
    sections: dict = {}
    current = global_scope
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            line = _strip_comment(line).strip()
            if not line:
                continue
            if line.startswith("[") and line.endswith("]"):
                name = line[1:-1].strip()
                sections[name] = {}
                current = sections[name]
                continue
            if "=" in line:
                key, _, val = line.partition("=")
                current[key.strip()] = val.strip()
    return ParsedConfig(global_scope, sections, path=path)
