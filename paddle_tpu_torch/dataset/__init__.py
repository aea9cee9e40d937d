"""Dataset readers (reference: python/paddle/dataset/).  Local files
only; where they are absent a reader yields synthetic samples made from
a fixed seed."""
