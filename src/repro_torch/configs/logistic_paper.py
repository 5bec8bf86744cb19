"""The paper's own workload (Section V): logistic regression on the Amazon
Employee Access dataset after one-hot encoding with interactions —
l = 343474 parameters, N = 26220 training samples, NAG optimizer.
We treat it as a 1-"layer" linear model config; examples/logistic_amazon.py
uses a synthetic sparse proxy of the Kaggle dataset (offline container)."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="logistic-paper", family="linear",
    n_layers=1, d_model=343474, n_heads=1, n_kv_heads=1,
    d_ff=0, vocab=2,
    source="ICML18 Ye&Abbe Sec. V / kaggle amazon-employee-access-challenge",
)
