from .results import (  # noqa: F401
    argmax_predictions,
    compare_result_files,
    format_result_line,
    parse_result_line,
    write_results,
)
