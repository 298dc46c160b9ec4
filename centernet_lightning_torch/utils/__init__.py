from .convert import variables_to_state_dict

__all__ = ["variables_to_state_dict"]
