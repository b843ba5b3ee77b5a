from repro_torch.eval.metrics import accuracy, bleu, rouge_l, rouge_n, rouge_scores

__all__ = ["accuracy", "bleu", "rouge_n", "rouge_l", "rouge_scores"]
