"""Datasets of the port: loaders, collation and evaluators."""


def dataset_kind(dataset: str) -> str:
    """The family of ``dataset`` ("mol", "code2" or "tu"), which picks its
    loader, encoders, loss and evaluator; other datasets raise."""
    if dataset.startswith("ogbg-mol"):
        return "mol"
    if dataset == "ogbg-code2":
        return "code2"
    if dataset in ("NCI1", "NCI109"):
        return "tu"
    raise NotImplementedError(f"dataset {dataset}: the port runs the "
                              "ogbg-mol* datasets, ogbg-code2, NCI1 and "
                              "NCI109")
