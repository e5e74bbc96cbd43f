from cst_captioning_tpu_torch.eval.evaluator import Evaluator, evaluate_split

__all__ = ["Evaluator", "evaluate_split"]
