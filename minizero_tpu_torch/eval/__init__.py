from minizero_tpu_torch.eval.match import MatchResult, elo_from_win_rate, play_match  # noqa: F401
