from .image import (get_rotate_crop_image, get_minarea_rect_crop, resize_img,
                    base64_to_cv2)
from .draw import draw_ocr, text_visual, str_count
from ..config import str2bool, make_params
