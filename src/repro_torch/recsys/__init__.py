"""RecLLM, the paper's LLM-based recommender: the model, its synthetic
dataset and its ranking metrics."""
